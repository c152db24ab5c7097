"""Inference engine for trained LaDDer models, on one CUDA device or the CPU.

The port of ``ladder_tpu/serving/engine.py``, with the same public API:
images go in and come out NHWC (uint8, or float in [0,1]), and every path
pads client batches up to a fixed bucket (repeat-last rows), chunks batches
larger than ``serve_batch`` and strips the pad rows before returning. The
buckets keep ``ladder_tpu``'s semantics: with the CelebA encoder's
batch-statistic BatchNorm a request's result depends on the padded batch it
runs in, so the same request always takes the same bucket.

Numerics: in float32 mode every path runs with TF32 off for both cuDNN
convolutions and cuBLAS matmuls, so the card computes in full float32 like
the CPU and ``ladder_tpu``. ``dtype='bfloat16'`` runs the conv and dense
stacks in bf16 with float32 parameters, heads and norm statistics.

The decoder's four style stages run the hand-written norm-chain kernel on
a CUDA device (ops/norm_chain.py). serving/export.py writes the paths as
``torch.export`` graphs.

Spans (utils/profiling.py, recorded while a profiler runs): a batched
path's ``engine.call`` (path, rows, bucket) holds ``engine.pad``,
``engine.upload`` (the host rows to the device), ``engine.launch``
(``run_path``) and ``engine.download`` (the answer to the host, which
waits for the device); the counters ``engine.rows`` and
``engine.pad_rows`` count the real and the padding rows of each call.

Scale-out (``mesh_devices=N``, ``ladder_tpu``'s 1-D data mesh with
replicated parameters): one replica of the model on each of N devices
(cuda:0..N-1, or the ``devices`` given). Every path pads to its bucket as
on one device, splits the padded rows into N equal chunks, runs each chunk
on its own device in a thread of its own (the devices overlap) and
concatenates the results in row order. The CelebA encoder's batch-statistic
BatchNorm sees the statistics of the whole padded batch, as under
``ladder_tpu``'s GSPMD: the replicas sum their channel sums across the
devices (``_ReplicaGroup``, an all-reduce between the threads, summed in
device order on every device). ``generate`` and ``t_log_density`` draw or
take the whole batch on the first device and scatter its rows, so their
results are those of one device. Buckets that do not divide by N are
dropped; serve_batch must divide.
"""

from __future__ import annotations

import contextlib
import copy
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ladder_tpu_torch.models.layers import set_batchnorm_mesh
from ladder_tpu_torch.models.builder import (
    PRIORS_WITH_GM,
    PRIORS_WITH_INNER_VAE,
    PRIORS_WITH_PRIOR_MODEL,
    make_model,
)
from ladder_tpu_torch.ops.distributions import (
    gmm_cholesky,
    gmm_logpdf,
    sample_diag_gaussian,
    sample_gmm,
)
from ladder_tpu_torch.serving.bn_freeze import load_bn_stats
from ladder_tpu_torch.utils.checkpoint import CheckpointManager
from ladder_tpu_torch.utils.device import float32_exact, resolve_device
from ladder_tpu_torch.utils.profiling import count, span


def _pad_to(x, n):
    """Pad axis 0 up to n rows (repeat-last keeps shapes conv-safe)."""
    k = x.shape[0]
    if k == n:
        return x
    if k == 0:
        raise ValueError("empty batch (0 rows)")
    if k > n:
        raise ValueError(f"batch {k} exceeds bucket {n}")
    pad = np.broadcast_to(x[-1:], (n - k,) + x.shape[1:])
    return np.concatenate([x, pad], axis=0)


def render(model, z):
    """codes -> NHWC images clipped to [0,1]."""
    return model.decode(z).clamp(0.0, 1.0).permute(0, 2, 3, 1)


def run_path(model, name, x):
    """One serving path on a tensor on the model's device: NHWC float32
    images in [0,1] for 'encode', 'reconstruct' and 'represent', codes for
    'decode', t-space points for 'decode_representation'. The engine and
    the exported graphs (serving/export.py) run this one function."""
    if name == "decode":
        return render(model, x)
    if name == "decode_representation":
        return render(model, model.inner_decode(x)[0])
    mean, std = model.encode(x.permute(0, 3, 1, 2).contiguous())
    if name == "encode":
        return mean, std
    if name == "represent":
        return model.inner_encode(mean)
    if name == "reconstruct":
        return render(model, mean)
    raise ValueError(f"unknown serving path {name!r}")


def _to_numpy(out, n):
    if isinstance(out, tuple):
        return tuple(_to_numpy(o, n) for o in out)
    return out.cpu().numpy()[:n]


def _concat(parts):
    if isinstance(parts[0], tuple):
        return tuple(np.concatenate(p, axis=0) for p in zip(*parts))
    return np.concatenate(parts, axis=0)


class _ReplicaGroup:
    """An all-reduce between the threads that drive the replicas of one
    engine call: each replica's view (``view(i)``) is the mesh its
    BatchNorm layers see (models/layers.py: ``sharded``, ``world``,
    ``all_reduce_``). The sum is taken in replica order on every device,
    so every replica gets the same values."""

    def __init__(self, devices):
        self.world = len(devices)
        self.devices = devices
        self.barrier = threading.Barrier(self.world)
        self.slots = [None] * self.world

    def all_reduce_(self, rank, tensor):
        self.slots[rank] = tensor
        self.barrier.wait()
        total = self.slots[0].to(tensor.device, copy=True)
        for other in self.slots[1:]:
            total += other.to(tensor.device)
        self.barrier.wait()  # every replica has read every slot
        tensor.copy_(total)
        return tensor

    def view(self, rank):
        group = self

        class _View:
            sharded = True
            world = group.world

            def all_reduce_(self, tensor, op=None, tag=None):
                return group.all_reduce_(rank, tensor)

        return _View()


class InferenceEngine:
    """One trained model, ready to serve on ``device``.

    Parameters
    ----------
    config : the training config dict (utils/config.py schema).
    checkpoint_dir : override for config['checkpoint_dir'].
    gm_info_path : override for result_dir/GM_prior_info.npz ('ours'/'GMM').
    serve_batch : largest batch per device call; larger requests chunk.
    buckets : extra smaller batch sizes; a request runs at the smallest
        bucket that fits it.
    dtype : 'float32' (default) or 'bfloat16' for the conv/dense stacks.
    mesh_devices : 0 = the one ``device``; N > 0 = a replica on each of N
        devices, every batch split across them (see the module docstring).
    devices : the devices of a mesh (default cuda:0..N-1 with ``device``
        cuda, the one CPU with ``device`` cpu); a list such as
        ['cpu', 'cpu'] runs N CPU replicas.
    allow_uninitialized : serve random weights when checkpoints are missing.
    bn_stats_path : bn_stats.npz; freezes the CelebA encoder's BatchNorm to
        population statistics (per-row-deterministic serving).
    device : 'cuda' (default) or 'cpu'.
    """

    def __init__(self, config, checkpoint_dir=None, gm_info_path=None,
                 serve_batch=64, buckets=(1, 8), dtype=None, mesh_devices=0,
                 allow_uninitialized=False, bn_stats_path=None,
                 device="cuda", devices=None):
        self.device = resolve_device(device)
        self.serve_batch = int(serve_batch)
        mesh = self._mesh_devices(int(mesh_devices), devices)
        cfg = dict(config)
        if dtype is not None:
            cfg["dtype"] = dtype
        if checkpoint_dir is not None:
            cfg["checkpoint_dir"] = checkpoint_dir
        if bn_stats_path is not None:
            if cfg.get("exp_name") != "celeba":
                raise ValueError(
                    "bn_stats_path applies to CelebA models only "
                    f"(exp_name={cfg.get('exp_name')!r} has no BatchNorm)")
            cfg["bn_mode"] = "frozen"
        self.config = cfg
        self.buckets = sorted({int(b) for b in buckets
                               if 0 < int(b) < self.serve_batch
                               and (not mesh or int(b) % len(mesh) == 0)}
                              | {self.serve_batch})
        self.model = make_model(cfg)
        self.prior = cfg["prior"]
        if bn_stats_path is not None:
            self.model.set_bn_stats(load_bn_stats(bn_stats_path))

        ck = CheckpointManager(cfg)
        # a serving engine must not silently answer with random weights
        if not allow_uninitialized:
            missing = [p for p in [ck.path_vae]
                       + ([ck.path_prior]
                          if self.prior in PRIORS_WITH_PRIOR_MODEL else [])
                       if not os.path.isfile(p)]
            if missing:
                raise FileNotFoundError(
                    "serving requires trained checkpoints; missing: "
                    f"{missing} (pass allow_uninitialized=True to serve "
                    "random-init weights anyway)")
        params = ck.load(self.model.flax_params(), "VAE")
        if self.prior in PRIORS_WITH_PRIOR_MODEL:
            params = ck.load(params, "prior")
        self.model.load_flax_params(params)
        # the devices' list, or None on one device (export refuses a mesh)
        self.mesh = mesh
        if mesh:
            self.device = mesh[0]
        self.model.to(self.device).eval().requires_grad_(False)
        self._replicas = [self.model] + [
            copy.deepcopy(self.model).to(dev) for dev in (mesh or [])[1:]]
        self._pool = (ThreadPoolExecutor(len(mesh), "ladder-replica")
                      if mesh and len(mesh) > 1 else None)

        self.gm = self._load_gm(gm_info_path)
        self._latency = {}
        self._lock = threading.Lock()  # one device call at a time

    def _mesh_devices(self, n, devices):
        """The N devices of a mesh (None without one), after
        ``ladder_tpu``'s checks."""
        if not n:
            return None
        if devices is None:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if self.device.type == "cuda" else [self.device])
        devices = [resolve_device(d) for d in devices]
        if n > len(devices):
            raise ValueError(f"mesh_devices={n} but only {len(devices)} "
                             "devices are available")
        if self.serve_batch % n:
            raise ValueError(f"serve_batch={self.serve_batch} must be "
                             f"divisible by mesh_devices={n}")
        return devices[:n]

    # -- artifact loading ----------------------------------------------
    def _load_gm(self, gm_info_path):
        if self.prior not in PRIORS_WITH_GM:
            return None
        # explicit path -> the run's result_dir -> next to the checkpoint
        candidates = [gm_info_path] if gm_info_path else [
            os.path.join(self.config["result_dir"], "GM_prior_info.npz"),
            os.path.join(self.config["checkpoint_dir"], "GM_prior_info.npz"),
        ]
        path = next((p for p in candidates if p and os.path.isfile(p)), None)
        if path is None:
            return None
        with np.load(path) as info:
            w, m, K = (torch.tensor(np.asarray(info[k], np.float32))
                       for k in ("w_full", "m_full", "K_full"))
        # Cholesky on the host in float32, so every device samples and
        # scores with the same factors
        chols = gmm_cholesky(K)
        return {k: v.to(self.device)
                for k, v in dict(weights=w, means=m, chols=chols).items()}

    # -- device paths (tensors in, tensors out) ------------------------
    def _images(self, x, device=None):
        """NHWC uint8 or float -> NHWC float32 in [0,1] on the device."""
        t = torch.tensor(x, device=device or self.device)
        return t.float() * (1.0 / 255.0) if t.dtype == torch.uint8 else t.float()

    def _render(self, z):
        """codes -> NHWC images clipped to [0,1]."""
        return render(self.model, z)

    def _path(self, name, a, replica=0):
        """Serving path ``name`` on host rows ``a``, on a replica's device:
        images for 'encode', 'reconstruct' and 'represent', codes for
        'decode', t-space points for 'decode_representation' (the inner
        decoder's mean code, then the outer decoder)."""
        model = self._replicas[replica]
        device = next(model.parameters()).device
        with span("engine.upload"):
            if name in ("encode", "reconstruct", "represent"):
                x = self._images(a, device)
            else:
                x = torch.tensor(a, device=device)
        with span("engine.launch"):
            return run_path(model, name, x)

    def _on_replicas(self, fn, parts):
        """fn(replica, part) for each replica in its own thread, with the
        replicas' BatchNorm statistics summed across them; the results in
        replica order, on the host."""
        group = _ReplicaGroup(self.mesh)

        def work(i):
            device = self.mesh[i]
            guard = (torch.cuda.device(device) if device.type == "cuda"
                     else contextlib.nullcontext())
            set_batchnorm_mesh(self._replicas[i], group.view(i))
            try:
                with guard, torch.inference_mode():
                    return _to_numpy(fn(i, parts[i]), len(parts[i]))
            except BaseException:
                group.barrier.abort()  # no replica waits for this one
                raise
            finally:
                set_batchnorm_mesh(self._replicas[i], None)

        return list(self._pool.map(work, range(len(parts))))

    def _launch(self, name, a, n):
        """One padded batch through a path: on the one device, or split
        across the mesh's replicas."""
        if self._pool is None:
            out = self._path(name, a)
            with span("engine.download"):
                return _to_numpy(out, n)
        parts = np.split(a, len(self.mesh))
        out = _concat(self._on_replicas(
            lambda i, part: self._path(name, part, i), parts))
        if isinstance(out, tuple):
            return tuple(o[:n] for o in out)
        return out[:n]

    def _gen_codes(self, generator):
        n, cfg, gm, dev = self.serve_batch, self.config, self.gm, self.device
        if self.prior == "standard_gaussian":
            return sample_diag_gaussian(
                generator, torch.zeros(n, cfg["code_size"], device=dev),
                torch.ones(n, cfg["code_size"], device=dev))
        if self.prior == "GMM":
            return sample_gmm(generator, gm["weights"], gm["means"],
                              gm["chols"], n)
        if self.prior == "ours":
            t = sample_gmm(generator, gm["weights"], gm["means"],
                           gm["chols"], n)
            return self.model.inner_decode(t)[0]
        if self.prior == "hierarchical":
            t = sample_diag_gaussian(
                generator,
                torch.zeros(n, cfg["representation_size"], device=dev),
                torch.ones(n, cfg["representation_size"], device=dev))
            return self.model.inner_decode(t)[0]
        if self.prior == "vampPrior":
            mean, std = self.model.encode(self.model.pseudo_inputs())
            k = torch.randint(0, cfg["n_mixtures"], (n,),
                              generator=generator).to(dev)
            return sample_diag_gaussian(generator, mean[k], std[k])
        raise ValueError(self.prior)

    @contextlib.contextmanager
    def _device_call(self):
        """Serialised, gradient-free, and in float32 mode TF32-free."""
        exact = (float32_exact() if self.model.dtype is None
                 else contextlib.nullcontext())
        with self._lock, exact, torch.inference_mode():
            yield

    # -- public API -------------------------------------------------------
    def _bucket_for(self, n):
        """Smallest bucket that fits n rows."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.serve_batch

    def _check_rows(self, name, x, row_shape):
        if x.ndim != 1 + len(row_shape) or tuple(x.shape[1:]) != row_shape:
            raise ValueError(f"{name}: expected rows of shape {row_shape}, "
                             f"got array of shape {x.shape}")

    def _run(self, name, x, row_shape):
        x = np.asarray(x)
        self._check_rows(name, x, row_shape)
        n = x.shape[0]
        if n == 0:
            raise ValueError(f"{name}: empty batch (0 rows)")
        if n > self.serve_batch:
            return _concat([self._run(name, x[i:i + self.serve_batch],
                                      row_shape)
                            for i in range(0, n, self.serve_batch)])
        b = self._bucket_for(n)
        t0 = time.perf_counter()
        with span("engine.call", path=name, rows=n, bucket=b):
            count("engine.rows", n)
            count("engine.pad_rows", b - n)
            with span("engine.pad"):
                a = _pad_to(x, b)
            with self._device_call():
                out = self._launch(name, a, n)  # copies synchronise
        dt = time.perf_counter() - t0
        for key in (name, f"{name}@b{b}"):
            ema = self._latency.get(key)
            self._latency[key] = dt if ema is None else 0.9 * ema + 0.1 * dt
        return out

    def _image_shape(self):
        cfg = self.config
        return (cfg["dim_input_x"], cfg["dim_input_y"],
                cfg["dim_input_channel"])

    def encode(self, x):
        """images [N,H,W,C] (uint8 or [0,1] float) -> (code_mean, code_std)."""
        return self._run("encode", x, self._image_shape())

    def decode(self, z):
        """codes [N, code_size] -> images [N,H,W,C] clipped to [0,1]."""
        return self._run("decode", np.asarray(z, np.float32),
                         (self.config["code_size"],))

    def reconstruct(self, x):
        """images -> posterior-mean reconstructions in [0,1]."""
        return self._run("reconstruct", x, self._image_shape())

    def represent(self, x):
        """images -> representation (t_mean, t_std) ('ours'/'hierarchical')."""
        if self.prior not in PRIORS_WITH_INNER_VAE:
            raise ValueError(f"prior {self.prior} has no t-space")
        return self._run("represent", x, self._image_shape())

    def decode_representation(self, t):
        """t-space points [N, representation_size] -> images in [0,1]
        ('ours'/'hierarchical')."""
        if self.prior not in PRIORS_WITH_INNER_VAE:
            raise ValueError(f"prior {self.prior} has no t-space")
        return self._run("decode_representation", np.asarray(t, np.float32),
                         (self.config["representation_size"],))

    def generate(self, n, seed=0):
        """Sample n images from the configured prior (clipped to [0,1]).

        Noise comes from a CPU torch.Generator seeded with ``seed``, so a
        seed gives the same codes on every device; each device call decodes
        one serve_batch of samples."""
        if self.prior in PRIORS_WITH_GM and self.gm is None:
            raise ValueError("generation with prior='%s' needs "
                             "GM_prior_info.npz (run an accurate fit or pass "
                             "gm_info_path)" % self.prior)
        if n <= 0:
            return np.zeros((0,) + self._image_shape(), np.float32)
        generator = torch.Generator().manual_seed(int(seed))
        out = []
        remaining = n
        while remaining > 0:
            with self._device_call():
                codes = self._gen_codes(generator)
                if self._pool is None:
                    imgs = self._render(codes).cpu().numpy()
                else:  # the first device's codes, decoded across the mesh
                    imgs = _concat(self._on_replicas(
                        lambda i, z: render(self._replicas[i],
                                            z.to(self.mesh[i])),
                        codes.chunk(len(self.mesh))))
            out.append(imgs[:remaining])
            remaining -= imgs.shape[0]
        return np.concatenate(out, axis=0)

    def t_log_density(self, t):
        """log p_GM(t) under the accurate hyper-prior fit."""
        if self.gm is None:
            raise ValueError("no GM_prior_info.npz loaded")
        t = torch.tensor(np.asarray(t, np.float32), device=self.device)
        gm = self.gm
        with self._device_call():
            if self._pool is None or len(t) < len(self.mesh):
                return gmm_logpdf(t, gm["weights"], gm["means"],
                                  gm["chols"]).cpu().numpy()
            # the first device's rows, scored across the mesh
            return _concat(self._on_replicas(
                lambda i, part: gmm_logpdf(
                    part.to(self.mesh[i]),
                    *(gm[k].to(self.mesh[i])
                      for k in ("weights", "means", "chols"))),
                t.tensor_split(len(self.mesh))))

    def warmup(self):
        """Run every path at every bucket shape, in both accepted image
        dtypes (uint8 and float32); returns seconds taken."""
        cfg = self.config
        t0 = time.perf_counter()
        for b in self.buckets:
            for dtype in (np.float32, np.uint8):
                x = np.zeros((b,) + self._image_shape(), dtype)
                self.encode(x)
                self.reconstruct(x)
                if self.prior in PRIORS_WITH_INNER_VAE:
                    self.represent(x)
            self.decode(np.zeros((b, cfg["code_size"]), np.float32))
            if self.prior in PRIORS_WITH_INNER_VAE:
                self.decode_representation(
                    np.zeros((b, cfg["representation_size"]), np.float32))
        try:
            self.generate(1)
        except ValueError:
            pass  # no GM fit on disk — generation unavailable, not an error
        return time.perf_counter() - t0

    @property
    def latency_ema(self):
        """Per-path smoothed wall latency (seconds) of past calls."""
        return dict(self._latency)
