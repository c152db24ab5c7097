"""Sharded parameters and Adam moments over a 2-D (data, model) mesh (the
port of ``ladder_tpu/parallel/tp.py``).

``ladder_tpu`` annotates every parameter and Adam moment with a model-axis
sharding (``leaf_spec``) and leaves the compute to GSPMD, which partitions
the convs by output channel. PyTorch has no such partitioner, so the port
keeps the same layout at rest and the same global-batch function, and
computes as hybrid sharded data parallelism written out with
``torch.distributed`` collectives:

  * rows: every one of the n_data * n_model ranks takes its own rows of the
    global batch (parallel/mesh.py's DataMesh rules over the whole world:
    the global BatchNorm sums and the sigma floor's all-reduce included);
  * at rest: each parameter and both of its Adam moments are held as this
    rank's shard along the axis ``leaf_spec`` picks, in persistent
    contiguous tensors that the Adam kernel updates in place (its plan
    cache keys on their addresses); a leaf that does not shard is held
    whole, and its parameter is that tensor;
  * gather: before a forward, the full parameters of the groups it reads
    are gathered over the model axis (one all-gather of a flat buffer per
    call, counted under the tag 'param_gather'), and freed at the end of
    the step; a group updated by a sub-step is gathered again before the
    next forward reads it (mode 1);
  * gradients: averaged over the world (the DataMesh all-reduce); each rank
    keeps its shard of every gradient and applies the Adam kernel to it.
    The clip is elementwise, so a shard's update is the whole update
    restricted to the shard.

The compute is not channel-partitioned: every rank runs the whole model on
its rows. The function and the memory at rest are ``ladder_tpu``'s.

Layouts. ``ladder_tpu``'s rule shards the last axis divisible by n_model,
over the trailing two axes of a conv kernel (HWIO: out, then in) and over
both axes of a dense kernel ([in, out]: out, then in). The port's weights
are OIHW and [out, in] (utils/weights.py), so the same choice is axis 0
(out), then axis 1 (in); every other leaf keeps its layout and its rule.
The encoder's flattened-input dense kernels (``code_mean``,
``code_std_dev``, mnist ``Dense_0``), whose rows the weight bridge
permutes, shard on their output axis whenever the rule shards them there,
so the permutation stays inside every shard.
"""

from __future__ import annotations

import contextlib

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh_2d(n_data=None, n_model=2, world=None):
    """The (data, model) grid of ``world`` ranks: rank r sits at data index
    r // n_model and model index r % n_model. n_data defaults to
    world // n_model. Returns the grid as a list of rank lists, one per
    data index (each one model group)."""
    if world is None:
        world = (n_data or 1) * n_model
    if n_data is None:
        n_data = world // n_model
    need = n_data * n_model
    if world < need:
        raise ValueError(f"mesh {n_data}x{n_model} needs {need} ranks, "
                         f"have {world}")
    return [list(range(d * n_model, (d + 1) * n_model))
            for d in range(n_data)]


def model_axis_size(mesh):
    """Size of the model axis, or 0 when the mesh has none (a 1-D data
    mesh, or no mesh)."""
    return int(getattr(mesh, "n_model", 0) or 0)


def leaf_spec(shape, n_model, weight=False):
    """The axis this leaf shards along over the model axis, or None
    (replicated): ``ladder_tpu``'s rule in the port's layouts (see the
    module docstring). ``weight``: the leaf is a conv or dense weight in
    torch layout (OIHW or [out, in]), where the candidates are axis 0
    (out) then axis 1 (in). Otherwise the last axis divisible by n_model,
    over the trailing two axes when the leaf has three or more."""
    shape = tuple(shape)
    if n_model <= 1 or not shape:
        return None
    if weight and len(shape) in (2, 4):
        candidates = (0, 1)
    else:
        lo = len(shape) - 2 if len(shape) >= 3 else 0
        candidates = range(len(shape) - 1, lo - 1, -1)
    for ax in candidates:
        if shape[ax] % n_model == 0 and shape[ax] >= n_model:
            return ax
    return None


def is_weight(name, tensor):
    """A conv or dense weight in torch layout: the leaves the weight bridge
    transposes."""
    return name.rsplit(".", 1)[-1] == "weight" and tensor.dim() in (2, 4)


def _shard_of(full, axis, index, n_model, copy=True):
    """This rank's shard of a full tensor, contiguous: a new tensor, or
    with copy=False a view where one is contiguous (the whole tensor, or a
    slice of axis 0)."""
    if axis is None:
        return full.detach().clone() if copy else full.detach()
    size = full.shape[axis] // n_model
    return full.detach().narrow(axis, index * size, size).contiguous()


def shard_params_tp(tensors, specs, index, n_model, copy=True):
    """{name: full tensor} -> {name: this rank's contiguous shard} by
    ``specs`` ({name: axis or None}); new tensors unless copy=False."""
    return {k: _shard_of(t, specs[k], index, n_model, copy)
            for k, t in tensors.items()}


def gather_params_tp(shards, specs, mesh):
    """The reverse of shard_params_tp over the mesh's model group: {name:
    shard} -> {name: full tensor}, with one all-gather of a flat buffer of
    the sharded leaves (in the order of ``shards``). Every rank of the
    model group calls it with the same names."""
    names = [k for k in shards if specs[k] is not None]
    full = {k: v for k, v in shards.items() if specs[k] is None}
    if names:
        flat = torch.cat([shards[k].reshape(-1) for k in names])
        parts = mesh.gather_model(flat)
        offset = 0
        for k in names:
            s = shards[k]
            n = s.numel()
            full[k] = torch.cat([p[offset:offset + n].view(s.shape)
                                 for p in parts], dim=specs[k])
            offset += n
    return {k: full[k] for k in shards}


class ShardedState:
    """A train state's parameters and Adam moments held as this rank's
    shards (see the module docstring). Built from a full state (after
    init_state and the broadcast of rank 0's values) by
    ``shard_train_state``; the model's sharded parameters are then freed
    (empty tensors) until ``gather`` fills them.

    ``shards``: {parameter name: shard}; a train state's ``opt`` holds the
    moment shards in place of the full moments, the same objects from
    sharding to the end of the run."""

    def __init__(self, state, mesh):
        self.mesh = mesh
        self.n_model, self.index = mesh.n_model, mesh.model_rank
        model = state["model"]
        self.params = dict(model.named_parameters())
        self.specs = {k: leaf_spec(p.shape, self.n_model, is_weight(k, p))
                      for k, p in self.params.items()}
        self.full_shapes = {k: tuple(p.shape) for k, p in self.params.items()}
        self.opt = state["opt"]
        self.shards = shard_params_tp(self.params, self.specs, self.index,
                                      self.n_model)
        for group in self.opt.values():
            for moment in ("m", "v"):
                group[moment] = shard_params_tp(
                    group[moment], self.specs, self.index, self.n_model)
        # the persistent moment shards, which opt holds again after reshard
        self.moments = {name: {m: group[m] for m in ("m", "v")}
                        for name, group in self.opt.items()}
        device = next(iter(self.params.values())).device
        self._empty = torch.empty(0, device=device)
        self._stale = set(self.params)
        self._holds = self._wholes = 0
        self.free()

    # ---- the model's parameters ------------------------------------
    def free(self):
        """At rest: a sharded parameter holds nothing, a replicated one is
        its shard."""
        for k, p in self.params.items():
            p.data = self._empty if self.specs[k] is not None \
                else self.shards[k]
        self._stale = {k for k in self.params if self.specs[k] is not None}

    def gather(self):
        """Fill the full parameters that are not current (all of them at
        rest, an updated group's after a sub-step): one all-gather."""
        names = [k for k in self.params if k in self._stale]
        if not names:
            return
        with torch.no_grad():
            full = gather_params_tp({k: self.shards[k] for k in names},
                                    self.specs, self.mesh)
        for k in names:
            self.params[k].data = full[k]
        self._stale.difference_update(names)

    def updated(self, names):
        """The shards of ``names`` changed: their full parameters are stale
        (a replicated parameter is its shard and stays current)."""
        self._stale.update(k for k in names if self.specs[k] is not None)

    @contextlib.contextmanager
    def gathered(self):
        """Every full parameter inside the block, freed after the outermost
        such block."""
        self._holds += 1
        try:
            self.gather()
            yield
        finally:
            self._holds -= 1
            if not self._holds:
                self.free()

    def shard_grads(self, grads):
        """{name: full gradient} -> {name: this rank's contiguous shard}
        (a view where one is contiguous)."""
        return shard_params_tp(grads, self.specs, self.index, self.n_model,
                               copy=False)

    # ---- the whole state, for checkpoints and broadcasts ------------
    def unshard(self):
        """Full parameters in the model and full moments in ``opt`` (one
        all-gather per tensor list), until ``reshard``."""
        self.gather()
        for group in self.opt.values():
            for moment in ("m", "v"):
                group[moment] = gather_params_tp(group[moment], self.specs,
                                                 self.mesh)

    def reshard(self):
        """Copy the full values back into the persistent shards and free
        the full tensors (after unshard and a load or a broadcast)."""
        with torch.no_grad():
            for k, p in self.params.items():
                if self.specs[k] is not None:
                    self.shards[k].copy_(_shard_of(
                        p, self.specs[k], self.index, self.n_model, False))
            for name, group in self.opt.items():
                for moment in ("m", "v"):
                    mine = self.moments[name][moment]
                    for k, full in group[moment].items():
                        if full is not mine[k]:
                            mine[k].copy_(_shard_of(
                                full, self.specs[k], self.index,
                                self.n_model, False))
                    group[moment] = mine
        if self._holds:
            self._stale.clear()  # the full parameters are current
        else:
            self.free()

    @contextlib.contextmanager
    def whole(self):
        """The full state inside the block (collective), resharded after
        the outermost such block: the values written inside are kept."""
        if self._wholes:
            self._wholes += 1
            try:
                yield
            finally:
                self._wholes -= 1
            return
        self.unshard()
        self._wholes = 1
        try:
            yield
        finally:
            self._wholes = 0
            self.reshard()

    # ---- memory ------------------------------------------------------
    def predicted_bytes(self):
        """(this rank's bytes of parameters and moments by the rule, the
        replicated total): a sharded leaf holds 1/n_model of its bytes."""
        def nbytes(k):
            n = 1
            for d in self.full_shapes[k]:
                n *= d
            return n * 4

        leaves = list(self.params)
        for group in self.opt.values():
            leaves += list(group["m"]) + list(group["v"])
        total = sum(nbytes(k) for k in leaves)
        mine = sum(nbytes(k) // self.n_model if self.specs[k] is not None
                   else nbytes(k) for k in leaves)
        return mine, total

    def held_bytes(self):
        """The bytes the parameters, the shards and the moments hold now,
        each storage once."""
        seen, total = set(), 0
        tensors = list(self.params.values()) + list(self.shards.values())
        for group in self.opt.values():
            tensors += list(group["m"].values()) + list(group["v"].values())
        for t in tensors:
            if t.numel() and t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                total += t.numel() * t.element_size()
        return total


def shard_train_state(state, mesh):
    """Hold ``state``'s parameters and moments as this rank's shards of
    the mesh's model axis (in place); returns the ShardedState, also kept
    as state['tp']."""
    state["tp"] = ShardedState(state, mesh)
    return state["tp"]
