"""Inference for trained LaDDer models: the engine, the micro-batching
frontend, population BatchNorm statistics and torch.export of the engine's
paths (serve CLI: ../serve.py)."""

from ladder_tpu_torch.serving.batcher import Batcher
from ladder_tpu_torch.serving.engine import InferenceEngine
from ladder_tpu_torch.serving.export import export_inference, load_exported

__all__ = ["Batcher", "InferenceEngine", "export_inference",
           "load_exported"]
