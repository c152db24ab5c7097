"""Weight bridge: flax parameter trees <-> the port's module state.

The port's modules carry the flax module and parameter names, so a flax
path maps to a state-dict key by joining with '.', with these layout
changes:

- conv ``kernel`` [kh, kw, in, out] (HWIO) -> ``weight`` [out, in, kh, kw];
- dense ``kernel`` [in, out] -> ``weight`` [out, in];
- the CelebA encoder's ``code_mean`` / ``code_std_dev`` kernels read the
  final [B, 2, 2, C] map flattened in NHWC order (``ladder_tpu/models/
  celeba.py:65``: row (h*2 + w)*C + c). The port flattens NCHW
  (column c*4 + h*2 + w), so those rows are permuted;
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

_CELEBA_FLAT_HEADS = ("code_mean", "code_std_dev")


def _celeba_channels_flax(tree):
    enc = tree.get("encoder", {})
    if "Conv_5" in enc and any(h in enc for h in _CELEBA_FLAT_HEADS):
        return enc["Conv_5"]["kernel"].shape[3]
    return None


def _celeba_channels_torch(state):
    w = state.get("encoder.Conv_5.weight")
    return None if w is None else w.shape[0]


def _nhwc_rows_to_nchw(k, c):
    """[S*C, out] rows in (s, c) order -> [C*S, out] rows in (c, s) order."""
    s = k.shape[0] // c
    return k.reshape(s, c, -1).transpose(1, 0, 2).reshape(c * s, -1)


def _nchw_rows_to_nhwc(k, c):
    s = k.shape[0] // c
    return k.reshape(c, s, -1).transpose(1, 0, 2).reshape(s * c, -1)


def _is_flat_head(path, celeba_c):
    return (celeba_c is not None and path[0] == "encoder"
            and len(path) == 3 and path[1] in _CELEBA_FLAT_HEADS)


def flax_to_torch(tree):
    """Nested flax tree of arrays -> flat {state_dict key: np.ndarray}."""
    celeba_c = _celeba_channels_flax(tree)
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
                if _is_flat_head(path, celeba_c):
                    a = _nhwc_rows_to_nchw(a, celeba_c)
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
    celeba_c = _celeba_channels_torch(state)
    tree = {}
    for key, a in state.items():
        path = tuple(key.split("."))
        name = path[-1]
        if name == "weight":
            if a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                a = a.T
                if _is_flat_head(path, celeba_c):
                    a = _nchw_rows_to_nhwc(a, celeba_c)
            else:
                raise ValueError(f"weight {key} has rank {a.ndim}")
            name = "kernel"
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[name] = a.copy(order="C")
    return tree


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
