"""Weight bridge: flax parameter trees <-> the port's module state.

The port's modules carry the flax module and parameter names, so a flax
path maps to a state-dict key by joining with '.', with these layout
changes:

- conv ``kernel`` [kh, kw, in, out] (HWIO) -> ``weight`` [out, in, kh, kw];
- dense ``kernel`` [in, out] -> ``weight`` [out, in];
- the encoder's first dense layer after its last conv reads that conv's
  [B, H, W, C] map flattened in NHWC order (row (h*W + w)*C + c); the port
  flattens NCHW (row c*H*W + h*W + w), so the rows of that kernel are
  permuted. It is ``code_mean`` / ``code_std_dev`` in CelebA (``ladder_tpu/
  models/celeba.py:65``, the [B,2,2,h] map of ``Conv_5``) and ``Dense_0``
  in the mnist families (``ladder_tpu/models/mnist.py:42,88``: digit
  [B,4,4,h] from ``Conv_2``, fashion [B,2,2,h/2] from ``Conv_3``). The
  decoders' ``Dense_0`` feeds a 1x1 map and keeps its layout;
- everything else (biases, BatchNorm ``gamma``/``beta``, scalars, the
  VampPrior pseudo-inputs) keeps its name, shape and bytes.

Both directions are exact (pure index permutations), so flax -> torch ->
flax round-trips bit for bit. A train state ``{params, opt: {group: {m, v,
t}}, step}`` crosses the same way (``flax_state_to_torch``,
``torch_state_to_flax``): the moments of a kernel are laid out as the kernel
is, so they take the same transposes and row permutations. The mnist families' flattened dense inputs
(``models/mnist.py:42,88``) come with their port.
"""

from __future__ import annotations

import numpy as np

def _flat_layer(convs, dense):
    """(channels of the encoder's last conv, names of the dense layers
    that read its flattened map), or None. ``convs``: {conv index: output
    channels} of the encoder; ``dense``: its dense layer names."""
    if not convs:
        return None
    c = convs[max(convs)]
    if "Dense_0" in dense:                     # the mnist families
        return c, ("Dense_0",)
    return c, tuple(n for n in ("code_mean", "code_std_dev") if n in dense)


def _flat_layer_flax(tree):
    enc = tree.get("encoder", {})
    convs = {int(k[5:]): v["kernel"].shape[3] for k, v in enc.items()
             if k.startswith("Conv_")}
    return _flat_layer(convs, [k for k in enc if not k.startswith("Conv_")])


def _flat_layer_torch(state):
    convs, dense = {}, set()
    for key, a in state.items():
        path = key.split(".")
        if path[0] != "encoder" or len(path) != 3:
            continue
        if path[1].startswith("Conv_"):
            if path[2] == "weight":
                convs[int(path[1][5:])] = a.shape[0]
        else:
            dense.add(path[1])
    return _flat_layer(convs, dense)


def _nhwc_rows_to_nchw(k, c):
    """[S*C, out] rows in (s, c) order -> [C*S, out] rows in (c, s) order."""
    s = k.shape[0] // c
    return k.reshape(s, c, -1).transpose(1, 0, 2).reshape(c * s, -1)


def _nchw_rows_to_nhwc(k, c):
    s = k.shape[0] // c
    return k.reshape(c, s, -1).transpose(1, 0, 2).reshape(s * c, -1)


def _is_flat_input(path, flat):
    return (flat is not None and path[0] == "encoder" and len(path) == 3
            and path[1] in flat[1])


def flax_to_torch(tree):
    """Nested flax tree of arrays -> flat {state_dict key: np.ndarray}."""
    flat = _flat_layer_flax(tree)
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        a = np.asarray(node)
        name = path[-1]
        if name == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                if _is_flat_input(path, flat):
                    a = _nhwc_rows_to_nchw(a, flat[0])
                a = a.T
            else:
                raise ValueError(f"kernel {'/'.join(path)} has rank {a.ndim}")
            name = "weight"
        out[".".join(path[:-1] + (name,))] = a.copy(order="C")

    walk(tree, ())
    return out


def torch_to_flax(state):
    """Flat {state_dict key: array or tensor} -> nested flax tree of numpy
    arrays (the inverse of flax_to_torch)."""
    state = {k: _to_numpy(v) for k, v in state.items()}
    flat = _flat_layer_torch(state)
    tree = {}
    for key, a in state.items():
        path = tuple(key.split("."))
        name = path[-1]
        if name == "weight":
            if a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                a = a.T
                if _is_flat_input(path, flat):
                    a = _nchw_rows_to_nhwc(a, flat[0])
            else:
                raise ValueError(f"weight {key} has rank {a.ndim}")
            name = "kernel"
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[name] = a.copy(order="C")
    return tree


def flax_variables_to_torch(variables):
    """A flax variable tree {params, batch_stats} (models/densenet.py's
    BatchNorm keeps its running 'mean' and 'var' in batch_stats) -> one
    flat {state_dict key: np.ndarray}; the statistics keep their names and
    layout."""
    out = flax_to_torch(variables["params"])
    out.update(flax_to_torch(variables.get("batch_stats", {})))
    return out


def torch_to_flax_variables(state):
    """The inverse of flax_variables_to_torch: the 'mean' and 'var' leaves
    go to batch_stats, everything else to params."""
    stats = {k: v for k, v in state.items()
             if k.rsplit(".", 1)[-1] in ("mean", "var")}
    out = {"params": torch_to_flax({k: v for k, v in state.items()
                                    if k not in stats})}
    if stats:
        out["batch_stats"] = torch_to_flax(stats)
    return out


def flax_state_to_torch(state):
    """Flax-layout train state {params, opt: {group: {m, v, t}}, step} ->
    {params: flat, opt: {group: {m: flat, v: flat, t: int}}, step: int}.
    A group's m and v are flax subtrees of the group's parameters."""
    return dict(
        params=flax_to_torch(state["params"]),
        opt={name: dict(m=flax_to_torch(group["m"]),
                        v=flax_to_torch(group["v"]), t=int(group["t"]))
             for name, group in state["opt"].items()},
        step=int(state["step"]))


def torch_state_to_flax(state):
    """The inverse of flax_state_to_torch; t and step become int32 scalars
    as in ``ladder_tpu``'s state."""
    return dict(
        params=torch_to_flax(state["params"]),
        opt={name: dict(m=torch_to_flax(group["m"]),
                        v=torch_to_flax(group["v"]),
                        t=np.asarray(group["t"], np.int32))
             for name, group in state["opt"].items()},
        step=np.asarray(state["step"], np.int32))


def _to_numpy(v):
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)
