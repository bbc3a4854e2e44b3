"""Serving: the engine and its micro-batcher."""

from icafusion_tpu_torch.serve.batcher import MicroBatcher
from icafusion_tpu_torch.serve.engine import ServingEngine

__all__ = ["ServingEngine", "MicroBatcher"]
