"""Ahead-of-time export of the engine's inference paths with
``torch.export`` (the port of ``ladder_tpu/serving/export.py``).

``export_inference`` traces each path the prior supports ('encode',
'decode', 'reconstruct', 'represent', 'decode_representation') with the
trained weights held in the graph's state, at the engine's fixed
serve_batch, on float32 NHWC input, and writes ``<dir>/<name>.pt2`` with
``torch.export.save``. ``load_exported`` reads one back as a callable that
takes uint8 or [0,1] float images, as the engine does.

The one departure from ``ladder_tpu``: its ``.jaxexport`` artifacts need
JAX but not the package. A ``.pt2`` of a CelebA decoding path holds the
norm-chain operator ``torch.ops.ladder_tpu_torch.norm_chain_fwd``, so a
consumer needs torch and ``import ladder_tpu_torch.ops.norm_chain``, which
registers that operator (``load_exported`` imports it). On a CUDA device
the loaded graph launches the norm-chain kernel; on the CPU it runs the
plain version.

The engine computes float32 with TF32 off; the loaded callable runs the
graph the same way (``utils/device.py:float32_exact``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ladder_tpu_torch.models.builder import PRIORS_WITH_INNER_VAE
from ladder_tpu_torch.ops import norm_chain  # noqa: F401  (the operator)
from ladder_tpu_torch.serving.engine import run_path
from ladder_tpu_torch.utils.device import float32_exact


class _Path(torch.nn.Module):
    """One serving path of ``model`` as a module, for ``torch.export``."""

    def __init__(self, model, name):
        super().__init__()
        self.model = model
        self.name = name

    def forward(self, x):
        return run_path(self.model, self.name, x)


def _path_inputs(engine):
    """{path name: the float32 input shape it is exported at}."""
    cfg = engine.config
    b = engine.serve_batch
    img = (b, cfg["dim_input_x"], cfg["dim_input_y"],
           cfg["dim_input_channel"])
    shapes = {"encode": img, "decode": (b, cfg["code_size"]),
              "reconstruct": img}
    if engine.prior in PRIORS_WITH_INNER_VAE:
        shapes["represent"] = img
        shapes["decode_representation"] = (b, cfg["representation_size"])
    return shapes


def export_inference(engine, out_dir, names=None):
    """Write the engine's paths as ``torch.export`` graphs. Returns
    {name: path}.

    names: a subset of the paths the prior supports (all of them by
    default). Shapes are the engine's fixed serve_batch, the static-shape
    contract serving keeps.
    """
    if getattr(engine, "mesh", None) is not None:
        raise ValueError(
            "export_inference requires a single-device engine: a device "
            "mesh would be baked into the artifact and bind it to that "
            "device count. Build the engine with mesh_devices=0 for export.")
    shapes = _path_inputs(engine)
    unknown = set(names or ()) - set(shapes)
    if unknown:
        raise ValueError(f"paths {sorted(unknown)} are not served for prior "
                         f"{engine.prior!r} (have {sorted(shapes)})")
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    with engine._lock, float32_exact(), torch.no_grad():
        for name in (names or shapes):
            example = torch.zeros(shapes[name], dtype=torch.float32,
                                  device=engine.device)
            module = _Path(engine.model, name)
            # one real call first: the tensors the model caches on first
            # use (ops/image.py's resize matrices) are then real tensors,
            # which the graph holds as constants, and not tracing values
            module(example)
            program = torch.export.export(module, (example,))
            path = os.path.join(out_dir, f"{name}.pt2")
            torch.export.save(program, path)
            written[name] = path
    return written


def load_exported(path):
    """One ``.pt2`` artifact -> a plain callable.

    The graphs were traced on float32 images in [0,1]; the callable turns
    uint8 input into [0,1] first, so the engine's input contract ('uint8
    or [0,1] float') holds for exported paths too. Input goes to the
    graph's device; outputs are tensors there."""
    program = torch.export.load(path)
    module = program.module()
    device = next((t.device for t in program.state_dict.values()),
                  torch.device("cpu"))

    def call(x):
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        if x.dtype == torch.uint8:
            x = x.float() * (1.0 / 255.0)
        with float32_exact(), torch.inference_mode():
            return module(x.to(device=device, dtype=torch.float32))

    return call
