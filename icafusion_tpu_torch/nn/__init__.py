"""The port's layers: backbone and neck, fusion blocks, alternative
towers."""

from icafusion_tpu_torch.nn import backbones, fusion, layers

__all__ = ["layers", "fusion", "backbones"]
