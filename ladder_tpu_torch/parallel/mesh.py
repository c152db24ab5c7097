"""Data parallelism across processes with ``torch.distributed`` (the port of
``ladder_tpu/parallel/mesh.py``).

``ladder_tpu`` scales with GSPMD: a 1-D ('data',) device mesh, parameters
and optimiser state replicated, the batch sharded on its leading axis, and
every loss reduction written as a global mean, so that XLA inserts the
cross-replica sums (the gradient all-reduce, the CelebA encoder's
BatchNorm statistics, the sigma floor's mean pixel error). The port runs
one process per rank (``torchrun``) and writes those collectives out. The
rule they keep: R ranks at a global batch B compute what one process
computes at batch B, up to the order of the float32 sums.

  * every rank holds the whole model and the same optimiser state
    (``replicate`` broadcasts rank 0's after an init or a restore);
  * each rank takes rows [r*B/R, (r+1)*B/R) of every global batch
    (``rows``, ``shard_batch``), and draws the global batch's noise from
    the same generator and keeps its own rows (``randn_rows``), so the
    generators stay in step with one process's;
  * the train step averages each backward's gradients across the ranks
    in one flat buffer before the clip and the Adam kernel
    (``average_``), and the metrics it returns (``average_metrics``);
  * BatchNorm's batch statistics and the output stage's L1 sum behind
    the sigma floor are summed across the ranks inside the autograd graph
    (``all_reduce_sum``: its backward is an all-reduce too).

``DataMesh.whole_batch()`` turns the sharding off for a block: every rank
then runs the same whole batch with local statistics and local noise, and
no collective; the trainer uses it for the forwards whose results only the
lead writes (the plots' decodes and prior samples), so that every rank
still consumes the same draws and none waits in a collective the others
never enter.

Collectives used: all_reduce, all_gather, broadcast and barrier, which
both NCCL and gloo (CUDA tensors included, staged through the host) offer.
``make_mesh`` (``ladder_tpu``'s name) joins the process group from
torchrun's environment and returns the mesh: a DataMesh, or for a
mesh_shape [n_data, n_model] a Mesh2D, which adds the model-axis groups
over which parallel/tp.py shards the parameters and moments
(``shard_state``).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from ladder_tpu_torch.utils.device import resolve_device


def check_mesh_shape(shape, world=1):
    """config['mesh_shape'] against the number of ranks, as ``ladder_tpu``
    reads it: None or [N] with N >= world is a data mesh over the world
    ranks (``devices[:n]`` on fewer devices); N < world leaves ranks with
    nothing to do. [n_data, n_model] is the (data, model) mesh
    (parallel/tp.py): the world must be a multiple of n_model (whole model
    groups) and at most n_data * n_model; one rank trains on its one
    device whatever the mesh says, as ``ladder_tpu``'s train.py does on
    one device. Three or more axes are refused as ``ladder_tpu`` refuses
    them."""
    if not shape:
        return
    shape = [int(n) for n in shape]
    if len(shape) > 2:
        raise ValueError(
            f"mesh_shape {shape} has {len(shape)} axes; supported are "
            "[n_data] (data parallel) and [n_data, n_model] (tensor "
            "parallel) - a 3-D mesh would silently flatten to 1-D data "
            "parallelism, so fail loudly instead")
    if len(shape) == 2:
        n_data, n_model = shape
        if n_data < 1 or n_model < 1:
            raise ValueError(f"mesh_shape {shape}: both axes must be >= 1")
        if world == 1:
            return
        if world % n_model:
            raise ValueError(
                f"mesh_shape {shape}: {world} ranks are not a multiple of "
                f"n_model={n_model}; every model group needs all its ranks")
        if world > n_data * n_model:
            raise ValueError(
                f"mesh_shape {shape} holds {n_data * n_model} ranks, "
                f"{world} were started: {world - n_data * n_model} of them "
                "would have nothing to do")
        return
    if shape[0] < world:
        raise ValueError(
            f"mesh_shape {shape} is smaller than the {world} ranks started: "
            f"{world - shape[0]} of them would have nothing to do; start at "
            f"most {shape[0]}")


def _stat():
    return {"calls": 0, "bytes": 0, "seconds": 0.0}


class DataMesh:
    """A 1-D data mesh over the ranks of a process group: this process's
    rank, the world size, its device, and the collectives the port uses.
    ``stats`` counts, per tag, the collective calls, their bytes and the
    host seconds spent inside them (for gloo that includes waiting for the
    device to finish what produced the tensor)."""

    def __init__(self, rank, world, device, group=None, backend=None):
        self.rank, self.world = int(rank), int(world)
        self.device = torch.device(device)
        self.group = group
        self.backend = backend
        self.sharded = True
        self.stats = {}

    @property
    def is_lead(self):
        """Rank 0 writes every file (``ladder_tpu``'s process 0)."""
        return self.rank == 0

    def __repr__(self):
        return (f"DataMesh(rank={self.rank}, world={self.world}, "
                f"device={self.device}, backend={self.backend})")

    # ---- rows --------------------------------------------------------
    def rows(self, n):
        """This rank's rows of a global batch of n: a slice; raises when n
        does not divide across the ranks (rows would silently drop)."""
        if n % self.world:
            raise ValueError(
                f"global batch of {n} rows does not divide across "
                f"{self.world} ranks - rows would silently drop and the "
                "ranks would no longer compute the global batch; pick "
                "batch_size % world_size == 0")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    @contextlib.contextmanager
    def whole_batch(self):
        """Within the block every rank runs whole batches alone (see the
        module docstring)."""
        old, self.sharded = self.sharded, False
        try:
            yield
        finally:
            self.sharded = old

    # ---- collectives ---------------------------------------------------
    @contextlib.contextmanager
    def _counted(self, tag, tensor):
        stat = self.stats.setdefault(tag, _stat())
        t0 = time.perf_counter()
        yield
        stat["calls"] += 1
        stat["bytes"] += tensor.numel() * tensor.element_size()
        stat["seconds"] += time.perf_counter() - t0

    def all_reduce_(self, tensor, op=dist.ReduceOp.SUM, tag="sum"):
        """In-place all-reduce of a contiguous tensor; returns it."""
        with self._counted(tag, tensor):
            dist.all_reduce(tensor, op=op, group=self.group)
        return tensor

    def broadcast_(self, tensor, src=0, tag="broadcast"):
        with self._counted(tag, tensor):
            dist.broadcast(tensor, src, group=self.group)
        return tensor

    def all_gather_rows(self, tensor, tag="gather"):
        """[n, ...] on every rank -> [world*n, ...], rank 0's rows first
        (the row order of the global batch)."""
        tensor = tensor.contiguous()
        parts = [torch.empty_like(tensor) for _ in range(self.world)]
        with self._counted(tag, tensor):
            dist.all_gather(parts, tensor, group=self.group)
        return torch.cat(parts)

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def any(self, flag):
        """True on every rank when ``flag`` is true on any."""
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        return bool(self.all_reduce_(t, op=dist.ReduceOp.MAX,
                                     tag="flag").item())

    def average_(self, tensors, tag="grad"):
        """Average same-dtype tensors across the ranks in one flat buffer,
        in place (the gradient all-reduce: a sum, then / world)."""
        tensors = list(tensors)
        if not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce_(flat, tag=tag).div_(self.world)
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n

    def average_metrics(self, tree, tag="metrics"):
        """A nested dict of small detached tensors -> the same dict with
        every tensor averaged across the ranks (one all-reduce): the
        batch means of the global batch."""
        leaves = []

        def walk(node):
            if isinstance(node, dict):
                for v in node.values():
                    walk(v)
            else:
                leaves.append(node)

        walk(tree)
        if not leaves:
            return tree
        flat = torch.cat([t.detach().float().reshape(-1) for t in leaves])
        self.all_reduce_(flat, tag=tag).div_(self.world)
        offset, averaged = 0, []
        for t in leaves:
            n = t.numel()
            averaged.append(flat[offset:offset + n].view(t.shape).to(t.dtype))
            offset += n
        it = iter(averaged)

        def rebuild(node):
            if isinstance(node, dict):
                return {k: rebuild(v) for k, v in node.items()}
            return next(it)

        return rebuild(tree)

    def replicate_(self, tensors, src=0):
        """Broadcast rank ``src``'s values into ``tensors`` (in place), one
        flat buffer per dtype, so every rank starts bitwise equal."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            self.broadcast_(flat, src)
            offset = 0
            with torch.no_grad():
                for t in group:
                    n = t.numel()
                    t.copy_(flat[offset:offset + n].view_as(t))
                    offset += n


class Mesh2D(DataMesh):
    """A (data, model) mesh: a DataMesh over the whole world (every rank
    takes its own rows) plus this rank's model group, the n_model ranks
    r // n_model * n_model .. + n_model - 1, over which the parameters and
    moments are sharded (parallel/tp.py)."""

    def __init__(self, rank, world, device, n_model, model_group=None,
                 group=None, backend=None):
        super().__init__(rank, world, device, group=group, backend=backend)
        self.n_model = int(n_model)
        self.model_rank = self.rank % self.n_model
        self.model_group = model_group

    def __repr__(self):
        return (f"Mesh2D(rank={self.rank}, world={self.world}, "
                f"n_model={self.n_model}, device={self.device}, "
                f"backend={self.backend})")

    def gather_model(self, tensor, tag="param_gather"):
        """[n] on every rank of the model group -> its n_model tensors, in
        model-rank order."""
        tensor = tensor.contiguous()
        parts = [torch.empty_like(tensor) for _ in range(self.n_model)]
        with self._counted(tag, tensor):
            dist.all_gather(parts, tensor, group=self.model_group)
        return parts


def sharded(mesh):
    """The mesh when its rows are split across ranks, else None."""
    return mesh if mesh is not None and mesh.sharded else None


class _AllReduceSum(torch.autograd.Function):
    """Sum across the ranks; the gradient of every rank's copy of the sum
    is the sum of the ranks' gradients (another all-reduce)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.detach().clone().contiguous(), tag="sum")

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.clone().contiguous(),
                                    tag="sum_grad"), None


def all_reduce_sum(x, mesh):
    """Differentiable sum of ``x`` across the ranks of a sharded mesh; x
    itself otherwise."""
    mesh = sharded(mesh)
    if mesh is None:
        return x
    return _AllReduceSum.apply(x, mesh)


def randn_rows(generator, shape, mesh=None, axis=0, device=None):
    """Standard normals of ``shape`` (float32, on ``device``, else the
    generator's) drawn from ``generator``: on a sharded mesh the global
    batch's draws (``shape[axis]`` * world rows), of which this rank keeps
    its own, so every rank and one process consume the same stream."""
    mesh = sharded(mesh)
    shape = tuple(shape)
    if mesh is not None:
        shape = shape[:axis] + (shape[axis] * mesh.world,) + shape[axis + 1:]
    eps = torch.randn(shape, generator=generator, device=generator.device,
                      dtype=torch.float32)
    if mesh is not None:
        eps = eps.narrow(axis, mesh.rank * (shape[axis] // mesh.world),
                         shape[axis] // mesh.world)
    return eps.to(device) if device is not None else eps


def shard_batch(batch, mesh, axis=0):
    """This rank's rows of a global batch (a tensor or an array) along
    ``axis``; the batch itself without a sharded mesh."""
    mesh = sharded(mesh)
    if mesh is None:
        return batch
    index = [slice(None)] * axis + [mesh.rows(batch.shape[axis])]
    return batch[tuple(index)]


def place_global_batch(batch, mesh, device=None):
    """One logical global batch, the same on every rank (the data
    pipelines are seed-deterministic) -> this rank's rows on its device;
    raises on a batch that does not divide across the ranks."""
    rows = shard_batch(batch, mesh)
    if not torch.is_tensor(rows):
        rows = torch.as_tensor(np.ascontiguousarray(rows))
    return rows.to(device if device is not None else mesh.device)


def place_global_stack(stack, mesh, device=None):
    """place_global_batch for a [K, B, ...] multi-step stack: the batch
    axis (axis 1) is split across the ranks, the step axis kept whole."""
    rows = shard_batch(stack, mesh, axis=1)
    if not torch.is_tensor(rows):
        rows = torch.as_tensor(np.ascontiguousarray(rows))
    return rows.to(device if device is not None else mesh.device)


def pad_to_multiple(batch, multiple):
    """Pad the leading axis up to a rank-count multiple by tiling the
    batch, and return (padded, real_count) so callers can unweight.
    Handles batches smaller than the multiple (a final validation batch
    of 5 over 8 ranks)."""
    n = batch.shape[0]
    rem = n % multiple
    if rem == 0:
        return batch, n
    pad = multiple - rem
    tiles = [batch] + [batch[:min(n, pad - i * n)]
                       for i in range(-(-pad // n))]
    return np.concatenate(tiles, axis=0), n


def _distinct_devices(identities):
    """Raise when two ranks name one card: NCCL cannot put two ranks on
    one device."""
    seen = {}
    for rank, ident in enumerate(identities):
        if ident in seen:
            raise RuntimeError(
                f"ranks {seen[ident]} and {rank} are on the same card "
                f"({ident}); NCCL needs one card per rank. Start at most "
                "one rank per card, or name the gloo backend (--backend "
                "gloo), which stages CUDA tensors through the host")
        seen[ident] = rank


def make_mesh(config=None, device=None, backend=None):
    """The data mesh of this process: config['mesh_shape'] checked against
    the ranks started (check_mesh_shape), the process group joined from
    torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT) unless it is already. The device is ``device`` when
    given, else cuda:LOCAL_RANK; a device that does not exist raises,
    nothing falls back to the CPU. The backend is NCCL on CUDA and gloo on
    the CPU; gloo on CUDA only when ``backend`` names it. Two NCCL ranks on
    one card raise."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = resolve_device(device or f"cuda:{local}")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, not {dev}")
    shape = (config or {}).get("mesh_shape")
    check_mesh_shape(shape, world)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world,
                                init_method="env://")
    if backend == "nccl":
        probe = dist.new_group(backend="gloo")
        ident = (f"{socket.gethostname()}/"
                 f"{torch.cuda.get_device_properties(dev).uuid}")
        identities = [None] * world
        dist.all_gather_object(identities, ident, group=probe)
        dist.destroy_process_group(probe)
        _distinct_devices(identities)
    if shape and len(shape) == 2:
        from ladder_tpu_torch.parallel.tp import make_mesh_2d
        n_model = int(shape[1]) if world > 1 else 1  # one rank: one device
        mine = None
        # every rank creates every model group, in the same order
        for ranks in make_mesh_2d(n_model=n_model, world=world):
            group = dist.new_group(ranks)
            if rank in ranks:
                mine = group
        return Mesh2D(rank, world, dev, n_model, model_group=mine,
                      backend=backend)
    return DataMesh(rank, world, dev, backend=backend)


def shard_state(state, mesh):
    """The train state on the mesh (``ladder_tpu``'s shard_state): rank
    0's parameters and moments broadcast to every rank, then, on a (data,
    model) mesh, held as this rank's shards (parallel/tp.py; returns the
    ShardedState, also state['tp']). None on a 1-D mesh."""
    from ladder_tpu_torch.parallel.tp import model_axis_size, \
        shard_train_state
    tensors = list(state["model"].parameters())
    for group in state["opt"].values():
        tensors += list(group["m"].values()) + list(group["v"].values())
    mesh.replicate_(tensors)
    if model_axis_size(mesh) > 1:
        return shard_train_state(state, mesh)
    return None


def stats_delta(after, before):
    """Per tag, ``after`` - ``before`` of two copies of DataMesh.stats."""
    return {tag: {k: v - before.get(tag, _stat())[k] for k, v in s.items()}
            for tag, s in after.items()}


def copy_stats(mesh):
    return {tag: dict(s) for tag, s in mesh.stats.items()}
