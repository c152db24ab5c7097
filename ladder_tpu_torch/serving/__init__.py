"""Inference for trained LaDDer models: the engine, the micro-batching
frontend, and population BatchNorm statistics (serve CLI: ../serve.py)."""

from ladder_tpu_torch.serving.batcher import Batcher
from ladder_tpu_torch.serving.engine import InferenceEngine

__all__ = ["Batcher", "InferenceEngine"]
